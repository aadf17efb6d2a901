create or replace temp view wsv as
select d1.d_date_sk ws_sold_date_sk,
       word_order_time ws_sold_time_sk,
       d2.d_date_sk ws_ship_date_sk,
       i_item_sk ws_item_sk,
       bc.c_customer_sk ws_bill_customer_sk,
       bc.c_current_cdemo_sk ws_bill_cdemo_sk,
       bc.c_current_hdemo_sk ws_bill_hdemo_sk,
       bc.c_current_addr_sk ws_bill_addr_sk,
       sc.c_customer_sk ws_ship_customer_sk,
       sc.c_current_cdemo_sk ws_ship_cdemo_sk,
       sc.c_current_hdemo_sk ws_ship_hdemo_sk,
       sc.c_current_addr_sk ws_ship_addr_sk,
       wp_web_page_sk ws_web_page_sk,
       web_site_sk ws_web_site_sk,
       sm_ship_mode_sk ws_ship_mode_sk,
       w_warehouse_sk ws_warehouse_sk,
       p_promo_sk ws_promo_sk,
       word_order_id ws_order_number,
       wlin_quantity ws_quantity,
       i_wholesale_cost ws_wholesale_cost,
       i_current_price ws_list_price,
       wlin_sales_price ws_sales_price,
       wlin_coupon_amt ws_coupon_amt,
       wlin_ship_cost ws_ship_cost
from s_web_order
     join date_dim d1 on cast(word_order_date as date) = d1.d_date
     join s_web_order_lineitem on word_order_id = wlin_order_id
     join date_dim d2 on cast(wlin_ship_date as date) = d2.d_date
     join item on wlin_item_id = i_item_id
     left join customer bc on word_bill_customer_id = bc.c_customer_id
     left join customer sc on word_ship_customer_id = sc.c_customer_id
     left join web_site on word_web_site_id = web_site_id
     left join ship_mode on word_ship_mode_id = sm_ship_mode_id
     left join warehouse on wlin_warehouse_id = w_warehouse_id
     left join promotion on wlin_promotion_id = p_promo_id
     left join web_page on wlin_web_page_id = wp_web_page_id;

insert into web_sales
select ws_sold_date_sk, ws_sold_time_sk, ws_ship_date_sk, ws_item_sk,
       ws_bill_customer_sk, ws_bill_cdemo_sk, ws_bill_hdemo_sk,
       ws_bill_addr_sk, ws_ship_customer_sk, ws_ship_cdemo_sk,
       ws_ship_hdemo_sk, ws_ship_addr_sk, ws_web_page_sk, ws_web_site_sk,
       ws_ship_mode_sk, ws_warehouse_sk, ws_promo_sk, ws_order_number,
       ws_quantity, ws_wholesale_cost, ws_list_price, ws_sales_price,
       (ws_quantity * ws_list_price) - (ws_quantity * ws_sales_price)
           ws_ext_discount_amt,
       ws_quantity * ws_sales_price ws_ext_sales_price,
       ws_quantity * ws_wholesale_cost ws_ext_wholesale_cost,
       ws_quantity * ws_list_price ws_ext_list_price,
       cast(0.00 as decimal(7,2)) ws_ext_tax,
       ws_coupon_amt,
       ws_ship_cost ws_ext_ship_cost,
       (ws_quantity * ws_sales_price) - ws_coupon_amt ws_net_paid,
       (ws_quantity * ws_sales_price) - ws_coupon_amt ws_net_paid_inc_tax,
       ((ws_quantity * ws_sales_price) - ws_coupon_amt) + ws_ship_cost
           ws_net_paid_inc_ship,
       ((ws_quantity * ws_sales_price) - ws_coupon_amt) + ws_ship_cost
           ws_net_paid_inc_ship_tax,
       ((ws_quantity * ws_sales_price) - ws_coupon_amt)
           - (ws_quantity * ws_wholesale_cost) ws_net_profit
from wsv;
