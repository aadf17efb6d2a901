create or replace temp view ssv as
select i_item_sk ss_item_sk,
       d_date_sk ss_sold_date_sk,
       c_customer_sk ss_customer_sk,
       c_current_cdemo_sk ss_cdemo_sk,
       c_current_hdemo_sk ss_hdemo_sk,
       c_current_addr_sk ss_addr_sk,
       s_store_sk ss_store_sk,
       p_promo_sk ss_promo_sk,
       purc_purchase_id ss_ticket_number,
       plin_quantity ss_quantity,
       purc_purchase_time ss_sold_time_sk,
       i_wholesale_cost ss_wholesale_cost,
       i_current_price ss_list_price,
       plin_sale_price ss_sales_price,
       plin_coupon_amt ss_coupon_amt
from s_purchase
     join customer on purc_customer_id = c_customer_id
     join store on purc_store_id = s_store_id
     join date_dim on cast(purc_purchase_date as date) = d_date
     join s_purchase_lineitem on purc_purchase_id = plin_purchase_id
     join item on plin_item_id = i_item_id
     left join promotion on plin_promotion_id = p_promo_id;

insert into store_sales
select ss_sold_date_sk, ss_sold_time_sk, ss_item_sk, ss_customer_sk,
       ss_cdemo_sk, ss_hdemo_sk, ss_addr_sk, ss_store_sk, ss_promo_sk,
       ss_ticket_number, ss_quantity, ss_wholesale_cost, ss_list_price,
       ss_sales_price,
       (ss_quantity * ss_list_price) - (ss_quantity * ss_sales_price)
           ss_ext_discount_amt,
       ss_quantity * ss_sales_price ss_ext_sales_price,
       ss_quantity * ss_wholesale_cost ss_ext_wholesale_cost,
       ss_quantity * ss_list_price ss_ext_list_price,
       cast(0.00 as decimal(7,2)) ss_ext_tax,
       ss_coupon_amt,
       (ss_quantity * ss_sales_price) - ss_coupon_amt ss_net_paid,
       (ss_quantity * ss_sales_price) - ss_coupon_amt ss_net_paid_inc_tax,
       ((ss_quantity * ss_sales_price) - ss_coupon_amt)
           - (ss_quantity * ss_wholesale_cost) ss_net_profit
from ssv;
