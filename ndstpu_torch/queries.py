"""The rendered text of the queries the port's slices run on the card.

Each is an NDS template rendered as ``ndstpu/queries/streamgen.py``
renders it (rngseed 07291122510, stream 0): the q3 family's star-join
reports (``QUERIES``), the store-channel reports (``STORE_QUERIES``),
the store-channel rollup and window reports (``WINDOW_QUERIES``) and the
set-operation and distinct reports (``SETOP_QUERIES``).
``chip_smoke.py`` and :mod:`ndstpu_torch.profile` run them.
"""

QUERIES = {
    "q3": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 162
  and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100""",
    "q42": """select dt.d_year, item.i_category_id, item.i_category,
       sum(ss_ext_sales_price) total
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 12
  and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by total desc, dt.d_year, item.i_category_id, item.i_category
limit 100""",
    "q52": """select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 1999
group by dt.d_year, item.i_brand, item.i_brand_id
order by dt.d_year, ext_price desc, brand_id
limit 100""",
    "q55": """select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 7
  and d_moy = 11
  and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100""",
}

# q9's five ss_quantity buckets: (low, high, count threshold)
Q9_BUCKETS = ((1, 20, 50330), (21, 40, 16645), (41, 60, 40372),
               (61, 80, 5743), (81, 100, 20142))
STORE_QUERIES = {
    "q9": "select " + ",\n       ".join(
        f"""case when (select count(*)
                  from store_sales
                  where ss_quantity between {lo} and {hi}) > {t}
            then (select avg(ss_ext_discount_amt)
                  from store_sales
                  where ss_quantity between {lo} and {hi})
            else (select avg(ss_net_paid)
                  from store_sales
                  where ss_quantity between {lo} and {hi}) end bucket{b}"""
        for b, (lo, hi, t) in enumerate(Q9_BUCKETS, 1)) + """
from reason
where r_reason_sk = 1""",
    "q43": """select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_gmt_offset = -6
  and d_year = 1999
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
         wed_sales, thu_sales, fri_sales, sat_sales
limit 100""",
    "q88": "select *\nfrom " + ",\n     ".join(
        f"""(select count(*) {name}
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = {h} and time_dim.t_minute {op} 30
        and household_demographics.hd_dep_count = 3
        and store.s_store_name = 'ese') s{i}"""
        for i, (name, h, op) in enumerate(
            (("h8_30_to_9", 8, ">="), ("h9_to_9_30", 9, "<"),
             ("h9_30_to_10", 9, ">="), ("h10_to_10_30", 10, "<")), 1)),
    "q93": """select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           left outer join store_returns
             on (sr_item_sk = ss_item_sk
                 and sr_ticket_number = ss_ticket_number),
           reason
      where sr_reason_sk = r_reason_sk
        and r_reason_desc = 'reason 35') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100""",
}

# rollups with grouping(), ranks and windowed aggregates over aggregates
WINDOW_QUERIES = {
    "q36": """select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc)
           as rank_within_parent
from store_sales, date_dim d1, item, store
where d1.d_year = 1998
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and s_state in ('AL', 'GA', 'CA', 'CO', 'FL', 'ID', 'IL', 'IN')
group by rollup(i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100""",
    "q47": """with v1 as(
 select i_category, i_brand,
        s_store_name, s_company_name,
        d_year, d_moy,
        sum(ss_sales_price) sum_sales,
        avg(sum(ss_sales_price)) over
          (partition by i_category, i_brand,
                     s_store_name, s_company_name, d_year)
          avg_monthly_sales,
        rank() over
          (partition by i_category, i_brand,
                     s_store_name, s_company_name
           order by d_year, d_moy) rn
 from item, store_sales, date_dim, store
 where ss_item_sk = i_item_sk and
       ss_sold_date_sk = d_date_sk and
       ss_store_sk = s_store_sk and
       (
         d_year = 2001 or
         ( d_year = 2001-1 and d_moy =12) or
         ( d_year = 2001+1 and d_moy =1)
       )
 group by i_category, i_brand,
          s_store_name, s_company_name,
          d_year, d_moy),
 v2 as(
 select v1.i_category, v1.i_brand
        ,v1.s_store_name, v1.s_company_name
        ,v1.d_year, v1.d_moy
        ,v1.avg_monthly_sales
        ,v1.sum_sales, v1_lag.sum_sales psum, v1_lead.sum_sales nsum
 from v1, v1 v1_lag, v1 v1_lead
 where v1.i_category = v1_lag.i_category and
       v1.i_category = v1_lead.i_category and
       v1.i_brand = v1_lag.i_brand and
       v1.i_brand = v1_lead.i_brand and
       v1.s_store_name = v1_lag.s_store_name and
       v1.s_store_name = v1_lead.s_store_name and
       v1.s_company_name = v1_lag.s_company_name and
       v1.s_company_name = v1_lead.s_company_name and
       v1.rn = v1_lag.rn + 1 and
       v1.rn = v1_lead.rn - 1)
  select  *
 from v2
 where  d_year = 2001 and
        avg_monthly_sales > 0 and
        case when avg_monthly_sales > 0 then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales else null end > 0.1
 order by sum_sales - avg_monthly_sales, 3
 limit 100""",
    "q67": """select  *
from (select i_category
            ,i_class
            ,i_brand
            ,i_product_name
            ,d_year
            ,d_qoy
            ,d_moy
            ,s_store_id
            ,sumsales
            ,rank() over (partition by i_category order by sumsales desc) rk
      from (select i_category
                  ,i_class
                  ,i_brand
                  ,i_product_name
                  ,d_year
                  ,d_qoy
                  ,d_moy
                  ,s_store_id
                  ,sum(coalesce(ss_sales_price*ss_quantity,0)) sumsales
            from store_sales
                ,date_dim
                ,store
                ,item
       where  ss_sold_date_sk=d_date_sk
          and ss_item_sk=i_item_sk
          and ss_store_sk = s_store_sk
          and d_month_seq between 1193 and 1193+11
       group by  rollup(i_category, i_class, i_brand, i_product_name, d_year, d_qoy, d_moy,s_store_id))dw1) dw2
where rk <= 100
order by i_category
        ,i_class
        ,i_brand
        ,i_product_name
        ,d_year
        ,d_qoy
        ,d_moy
        ,s_store_id
        ,sumsales
        ,rk
limit 100""",
    "q89": """select *
from (select i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price)) over (partition by i_category,
                 i_brand, s_store_name, s_company_name) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_year in (1998)
        and ((i_category in ('Books', 'Electronics', 'Sports')
              and i_class in ('computers', 'stereo', 'football'))
             or (i_category in ('Men', 'Jewelry', 'Women')
                 and i_class in ('shirts', 'birdal', 'dresses')))
      group by i_category, i_class, i_brand, s_store_name, s_company_name,
               d_moy) tmp1
where case when avg_monthly_sales <> 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100""",
    "q98": """select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) as itemrevenue,
       sum(ss_ext_sales_price) * 100 / sum(sum(ss_ext_sales_price))
           over (partition by i_class) as revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Men', 'Women', 'Jewelry')
  and ss_sold_date_sk = d_date_sk
  and d_date between cast('1999-02-22' as date)
                 and (cast('1999-02-22' as date) + interval 30 days)
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio""",
}

# set operations, DISTINCT and distinct aggregates: q2 (a UNION ALL of the
# web and catalog channels under a CTE referenced twice), q28 (six
# count(distinct) branches over store_sales), q41 (DISTINCT with a
# correlated count) and q76 (UNION ALL of the three channels)
SETOP_QUERIES = {
    "q2": """with wscs as
 (select sold_date_sk
        ,sales_price
  from (select ws_sold_date_sk sold_date_sk
              ,ws_ext_sales_price sales_price
        from web_sales
        union all
        select cs_sold_date_sk sold_date_sk
              ,cs_ext_sales_price sales_price
        from catalog_sales) u),
 wswscs as
 (select d_week_seq,
        sum(case when (d_day_name='Sunday') then sales_price else null end) sun_sales,
        sum(case when (d_day_name='Monday') then sales_price else null end) mon_sales,
        sum(case when (d_day_name='Tuesday') then sales_price else null end) tue_sales,
        sum(case when (d_day_name='Wednesday') then sales_price else null end) wed_sales,
        sum(case when (d_day_name='Thursday') then sales_price else null end) thu_sales,
        sum(case when (d_day_name='Friday') then sales_price else null end) fri_sales,
        sum(case when (d_day_name='Saturday') then sales_price else null end) sat_sales
 from wscs
     ,date_dim
 where d_date_sk = sold_date_sk
 group by d_week_seq)
 select d_week_seq1
       ,round(sun_sales1/sun_sales2,2) r_sun
       ,round(mon_sales1/mon_sales2,2) r_mon
       ,round(tue_sales1/tue_sales2,2) r_tue
       ,round(wed_sales1/wed_sales2,2) r_wed
       ,round(thu_sales1/thu_sales2,2) r_thu
       ,round(fri_sales1/fri_sales2,2) r_fri
       ,round(sat_sales1/sat_sales2,2) r_sat
 from
 (select wswscs.d_week_seq d_week_seq1
        ,sun_sales sun_sales1
        ,mon_sales mon_sales1
        ,tue_sales tue_sales1
        ,wed_sales wed_sales1
        ,thu_sales thu_sales1
        ,fri_sales fri_sales1
        ,sat_sales sat_sales1
  from wswscs,date_dim
  where date_dim.d_week_seq = wswscs.d_week_seq and
        d_year = 2001) y,
 (select wswscs.d_week_seq d_week_seq2
        ,sun_sales sun_sales2
        ,mon_sales mon_sales2
        ,tue_sales tue_sales2
        ,wed_sales wed_sales2
        ,thu_sales thu_sales2
        ,fri_sales fri_sales2
        ,sat_sales sat_sales2
  from wswscs,date_dim
  where date_dim.d_week_seq = wswscs.d_week_seq and
        d_year = 2001+1) z
 where d_week_seq1=d_week_seq2-53
 order by d_week_seq1""",
    "q28": """select *
from (select avg(ss_list_price) b1_lp, count(ss_list_price) b1_cnt,
             count(distinct ss_list_price) b1_cntd
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b1,
     (select avg(ss_list_price) b2_lp, count(ss_list_price) b2_cnt,
             count(distinct ss_list_price) b2_cntd
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b2,
     (select avg(ss_list_price) b3_lp, count(ss_list_price) b3_cnt,
             count(distinct ss_list_price) b3_cntd
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b3,
     (select avg(ss_list_price) b4_lp, count(ss_list_price) b4_cnt,
             count(distinct ss_list_price) b4_cntd
      from store_sales
      where ss_quantity between 16 and 20
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b4,
     (select avg(ss_list_price) b5_lp, count(ss_list_price) b5_cnt,
             count(distinct ss_list_price) b5_cntd
      from store_sales
      where ss_quantity between 21 and 25
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b5,
     (select avg(ss_list_price) b6_lp, count(ss_list_price) b6_cnt,
             count(distinct ss_list_price) b6_cntd
      from store_sales
      where ss_quantity between 26 and 30
        and (ss_list_price between 180 and 180 + 10
             or ss_coupon_amt between 3109 and 3109 + 1000
             or ss_wholesale_cost between 62 and 62 + 20)) b6
limit 100""",
    "q41": """select distinct(i_product_name)
 from item i1
 where i_manufact_id between 684 and 684+40
   and (select count(*) as item_cnt
        from item
        where (i_manufact = i1.i_manufact and
        ((i_category = 'Women' and
        (i_color = 'powder' or i_color = 'khaki') and
        (i_units = 'Ounce' or i_units = 'Oz') and
        (i_size = 'medium' or i_size = 'extra large')
        ) or
        (i_category = 'Women' and
        (i_color = 'brown' or i_color = 'honeydew') and
        (i_units = 'Bunch' or i_units = 'Ton') and
        (i_size = 'N/A' or i_size = 'small')
        ) or
        (i_category = 'Men' and
        (i_color = 'floral' or i_color = 'deep') and
        (i_units = 'N/A' or i_units = 'Dozen') and
        (i_size = 'petite' or i_size = 'petite')
        ) or
        (i_category = 'Men' and
        (i_color = 'light' or i_color = 'cornflower') and
        (i_units = 'Box' or i_units = 'Pound') and
        (i_size = 'medium' or i_size = 'extra large')
        ))) or
       (i_manufact = i1.i_manufact and
        ((i_category = 'Women' and
        (i_color = 'midnight' or i_color = 'snow') and
        (i_units = 'Pallet' or i_units = 'Gross') and
        (i_size = 'medium' or i_size = 'extra large')
        ) or
        (i_category = 'Women' and
        (i_color = 'cyan' or i_color = 'papaya') and
        (i_units = 'Cup' or i_units = 'Dram') and
        (i_size = 'N/A' or i_size = 'small')
        ) or
        (i_category = 'Men' and
        (i_color = 'orange' or i_color = 'frosted') and
        (i_units = 'Each' or i_units = 'Tbl') and
        (i_size = 'petite' or i_size = 'petite')
        ) or
        (i_category = 'Men' and
        (i_color = 'forest' or i_color = 'ghost') and
        (i_units = 'Lb' or i_units = 'Bundle') and
        (i_size = 'medium' or i_size = 'extra large')
        )))) > 0
 order by i_product_name
 limit 100""",
    "q76": """select channel, col_name, d_year, d_qoy, i_category, count(*) sales_cnt,
       sum(ext_sales_price) sales_amt
from (select 'store' as channel, 'ss_store_sk' col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price ext_sales_price
      from store_sales, item, date_dim
      where ss_store_sk is null
        and ss_sold_date_sk = d_date_sk
        and ss_item_sk = i_item_sk
      union all
      select 'web' as channel, 'ws_ship_customer_sk' col_name, d_year,
             d_qoy, i_category, ws_ext_sales_price ext_sales_price
      from web_sales, item, date_dim
      where ws_ship_customer_sk is null
        and ws_sold_date_sk = d_date_sk
        and ws_item_sk = i_item_sk
      union all
      select 'catalog' as channel, 'cs_ship_addr_sk' col_name, d_year,
             d_qoy, i_category, cs_ext_sales_price ext_sales_price
      from catalog_sales, item, date_dim
      where cs_ship_addr_sk is null
        and cs_sold_date_sk = d_date_sk
        and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100""",
}
